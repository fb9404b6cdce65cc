"""Mamba2 / SSD blocks (port of ``repro.models.ssm``).

The chunked SSD scan (prefill and append: the chunk-local quadratic term
plus the recurrence across chunks) and the O(1) recurrent decode step.
State of one layer:

* ``ssm``    — (b, H, P, N) f32: per-head state (P = head_dim, N = d_state)
* ``conv_*`` — (b, conv_width-1, dim): the causal conv's tail for x / B / C

The five input projections and ``out_proj`` are plain matmuls, as the
reference leaves them to XLA; the device work between them goes through
the kernel wrappers: for a sequence ``causal_conv`` (one launch over x, B
and C concatenated) and ``ssd_chunk_scan``, for a decode token
``ssm_step`` (the token's conv and the recurrence in one launch).  The
reference's ``sharding.constrain`` (:21, :125) does nothing on one card
and is left out.  :func:`ssd_scan_with_tails` and
:func:`ssm_decode_step` update the state they are given in place (the
reference returns a new one), so the engines' stacked state is never
copied per step.  Training differentiates :func:`ssd_scan` (no state in
place): the conv and the scan go through their wrappers' autograd
Functions, whose backwards are ``causal_conv_bwd`` and
``ssd_chunk_scan_bwd``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import causal_conv, ssd_chunk_scan, ssm_step
from repro_torch.models.layers import rms_norm

_CONV = ("conv_x", "conv_B", "conv_C")


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads, s.head_dim, s.n_groups * s.d_state


def _dt(p, x):
    """dt = softplus(x·w_dt + dt_bias) in f32, without a threshold:
    log(1 + e^v)."""
    return torch.logaddexp(
        (x @ p["w_dt"]).float() + p["dt_bias"].float(),
        torch.zeros((), device=x.device))


def _inputs(p, cfg: ModelConfig, x, conv_tails: Optional[Dict] = None):
    """The projections and the conv of the scan.  Returns (z, x, B, C, dt
    (f32, after softplus), the new tails)."""
    d_inner, _, _, N = _dims(cfg)
    b = x.shape[0]
    z = x @ p["w_z"]
    xbc = torch.cat([x @ p["w_x"], x @ p["w_B"], x @ p["w_C"]], dim=-1)
    w = torch.cat([p[k] for k in _CONV], dim=-1)
    if conv_tails is None:
        tail = xbc.new_zeros((b, w.shape[0] - 1, xbc.shape[-1]))
    else:
        tail = torch.cat([conv_tails[k] for k in _CONV], dim=-1)
    out, new_tail = causal_conv(xbc, w.contiguous(), tail.contiguous())
    xb, B, C = out.split((d_inner, N, N), dim=-1)
    tails = dict(zip(_CONV, new_tail.split((d_inner, N, N), dim=-1)))
    return z, xb, B, C, _dt(p, x), tails


def _gated_out(p, cfg: ModelConfig, y, z):
    """``out_proj(norm(y · silu(z)))`` with y cast to the activation dtype
    first (``ssm.py:123-125``)."""
    y = y.to(z.dtype)
    g = z * torch.sigmoid(z)             # jax.nn.silu's x * sigmoid(x)
    return rms_norm(y * g, p["out_norm"], cfg.rms_norm_eps) @ p["out_proj"]


def _scan(p, cfg: ModelConfig, x, h0, tails, h_out=None):
    d_inner, H, P, N = _dims(cfg)
    b, s, _ = x.shape
    z, xb, B, C, dt, new_tails = _inputs(p, cfg, x, tails)
    A = -torch.exp(p["A_log"].float())
    y, h = ssd_chunk_scan(xb.view(b, s, H, P), B, C, dt, A, p["D"], h0,
                          cfg.ssm.chunk_size, out_state=h_out)
    return _gated_out(p, cfg, y.view(b, s, d_inner), z), h, new_tails


def ssd_scan(p, cfg: ModelConfig, x, initial_state=None,
             conv_tails_in=None):
    """Chunked SSD over a sequence: x (b, s, d_model) -> (y (b, s,
    d_model), the final state {"ssm", "conv_x/B/C"}, new tensors)."""
    h0 = None if initial_state is None else initial_state.float()
    out, h, tails = _scan(p, cfg, x, h0, conv_tails_in)
    return out, dict(tails, ssm=h)


def ssd_scan_with_tails(p, cfg: ModelConfig, x, state: Dict):
    """Continue the scan from a carried state (the engines' append),
    updating ``state`` in place; returns (y, state)."""
    out, _, tails = _scan(p, cfg, x, state["ssm"],
                          {k: state[k] for k in _CONV}, h_out=state["ssm"])
    for k in _CONV:
        state[k].copy_(tails[k])
    return out, state


def ssm_decode_step(p, cfg: ModelConfig, x, state: Dict):
    """One token per sequence: x (b, 1, d_model) against ``state``,
    updated in place.  The token's conv and the recurrence are one
    ``ssm_step`` launch, which updates the state and all three tails in
    place.  Returns (y (b, 1, d_model), state)."""
    d_inner, H, P, N = _dims(cfg)
    b = x.shape[0]
    z = x @ p["w_z"]
    A = -torch.exp(p["A_log"].float())
    y = ssm_step(
        state["ssm"], (x @ p["w_x"])[:, 0].view(b, H, P),
        (x @ p["w_B"])[:, 0], (x @ p["w_C"])[:, 0], *(p[k] for k in _CONV),
        *(state[k] for k in _CONV), _dt(p, x)[:, 0].contiguous(), A, p["D"])
    return _gated_out(p, cfg, y.view(b, 1, d_inner), z), state


def init_ssm_state(cfg: ModelConfig, batch: int, device="cuda") -> Dict:
    """Zero state for ``batch`` sequences (``"meta"`` gives shapes only)."""
    d_inner, H, P, N = _dims(cfg)
    cw = cfg.ssm.conv_width
    dev = torch.device("meta") if str(device) == "meta" else resolve(device)
    dt = getattr(torch, cfg.param_dtype)
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=dev),
        "conv_x": torch.zeros((batch, cw - 1, d_inner), dtype=dt,
                              device=dev),
        "conv_B": torch.zeros((batch, cw - 1, N), dtype=dt, device=dev),
        "conv_C": torch.zeros((batch, cw - 1, N), dtype=dt, device=dev),
    }
