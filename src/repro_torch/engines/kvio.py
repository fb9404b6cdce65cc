"""KV state ↔ FullBlock bytes, slot utilities and the layerwise stream
(port of ``repro.engines.kvio``).

The engines keep decode state as padded device buffers, ``{"kv": {"k",
"v": (L, b, S, hkv, dh)}}`` for GQA and ``{"mla": {"c": (L, b, S, r),
"krope": (L, b, S, rd)}}`` for MLA; storage holds host FullBlocks ``(L,
tokens, row_bytes)`` uint8 with row = k ‖ v (GQA, 2·hkv·dh·itemsize
bytes) or c ‖ krope (MLA, (r + rd)·itemsize bytes: 1152 for ds27b), byte
for byte the reference's layout.  :func:`serialize_blocks` is the DE's
persist, which writes every layer into its FullBlock pages with one
launch of the ``kv_layer_scatter`` kernel.  :func:`layer_stream` is
layerwise loading (paper §4.1): the hit FullBlocks go to the card once
per install, and each layer's LayerBlock stream is gathered there by the
``kv_layer_gather`` kernel, with the next layer's gather already
submitted on the TrafficManager while the current layer is installed.

The SSM family keeps ``{"mamba": {"ssm": (L, b, H, P, N) f32,
"conv_x" / "conv_B" / "conv_C": (L, b, conv_width-1, dim)}}``, the batch
on axis 1 as everywhere, and its cache is one opaque state blob per
sequence: :func:`state_to_blob` lays a slot's leaves end to end as raw
bytes in a fixed order and :func:`blob_to_state` takes them back.  The
hybrid's state adds ``{"shared": {"k", "v": (n_apps, b, S, hkv, dh)}}``,
its shared attention block's K/V per application, and its blob carries
them after the Mamba2 leaves, padded to the engine's ``max_seq`` as the
reference's pickle of the whole slot carries them.  The reference
pickles a numpy tree; the port moves only the payload (no pickle
framing, and bf16 leaves need no numpy bf16 type), so its blob is that
many bytes shorter.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.traffic import TrafficClass, TrafficManager
from repro_torch.device import resolve
from repro_torch.kernels import kv_layer_gather, kv_layer_scatter
from repro_torch.models.model import init_decode_state
from repro_torch.models.params import require_ported


def batch_axes_of_state(cfg: ModelConfig):
    """Tree matching the decode state with each leaf's batch axis."""
    s3 = init_decode_state(cfg, 3, 8, device="meta")
    s4 = init_decode_state(cfg, 4, 8, device="meta")

    def find(a, b):
        if isinstance(a, dict):
            return {k: find(a[k], b[k]) for k in a}
        return next(i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                    if x != y)

    return find(s3, s4)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def slot_get(state, axes, slot: int):
    """A copy of one sequence's state (batch size 1)."""
    return _tree_map(lambda a, ax: a.narrow(ax, slot, 1).clone(), state, axes)


def slot_set(state, axes, slot: int, sub):
    """Write ``sub`` into ``slot`` of ``state`` in place; returns state."""
    _tree_map(lambda a, ax, s: a.narrow(ax, slot, 1).copy_(s),
              state, axes, sub)
    return state


# ---------------------------------------------------------------------------
# the SSM and hybrid families' state blob
# ---------------------------------------------------------------------------

BLOB_LEAVES = ("ssm", "conv_x", "conv_B", "conv_C")
SHARED_LEAVES = ("k", "v")


def _blob_leaves(state):
    """(group, leaf) of each leaf a blob holds, in blob order: the Mamba2
    leaves, then a hybrid's shared K/V."""
    return [("mamba", k) for k in BLOB_LEAVES] + \
        [("shared", k) for k in SHARED_LEAVES if "shared" in state]


def state_to_blob(state) -> np.ndarray:
    """A one-sequence SSM or hybrid state (batch 1) -> its leaves' bytes
    end to end in ``BLOB_LEAVES`` order, then a hybrid's shared ``k``
    and ``v``, a 1-D uint8 host array: one device-to-host copy."""
    return torch.cat([state[g][k].contiguous().view(-1).view(torch.uint8)
                      for g, k in _blob_leaves(state)]).cpu().numpy()


def blob_to_state(cfg: ModelConfig, blob: np.ndarray, device="cuda",
                  max_seq: int = 0):
    """The inverse of :func:`state_to_blob`: the blob goes to ``device``
    in one host-to-device copy and each leaf is a view of it.  A
    hybrid's shared K/V are ``max_seq`` tokens long, the engine's cache
    length the blob was taken at."""
    like = init_decode_state(cfg, 1, max_seq, device="meta")
    buf = torch.from_numpy(np.ascontiguousarray(blob)).to(resolve(device))
    leaves = _blob_leaves(like)
    need = sum(like[g][k].numel() * like[g][k].element_size()
               for g, k in leaves)
    if buf.numel() != need:
        raise ValueError(f"{cfg.name}: a state blob of {buf.numel()} bytes, "
                         f"the state has {need} (max_seq {max_seq})")
    out, off = {g: {} for g, _ in leaves}, 0
    for g, k in leaves:
        t = like[g][k]
        n = t.numel() * t.element_size()
        out[g][k] = buf[off:off + n].view(t.dtype).view(t.shape)
        off += n
    return out


# ---------------------------------------------------------------------------
# attention-layer enumeration (canonical layer order for serialisation)
# ---------------------------------------------------------------------------


def _kv_rows(cfg: ModelConfig) -> List[Tuple[str, tuple]]:
    """(state_key, stack_index) per attention layer, in layer order.  The
    port keeps one stack over all layers for the dense and the MoE
    family alike (the reference's MoE rows are ``("dense", (i,))`` then
    ``("moe", (i,))``; ``bridge.state_from_jax`` joins the two); the
    hybrid's rows are its shared block's applications, ``("shared",
    (i,))``, as the reference's."""
    require_ported(cfg)
    return [(_state_key(cfg), (li,)) for li in range(n_attn_layers(cfg))]


def _state_key(cfg: ModelConfig) -> str:
    if cfg.family == "hybrid":
        return "shared"
    return "mla" if cfg.attn_variant == "mla" else "kv"


def _row_parts(cfg: ModelConfig) -> Tuple[str, str]:
    """The two state leaves a FullBlock row holds, in row order."""
    return ("c", "krope") if cfg.attn_variant == "mla" else ("k", "v")


def kv_row_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    if cfg.attn_variant == "mla":
        return (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * dtype_bytes
    return 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes


def n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_period
    return cfg.n_layers


def _as_bytes(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """(..., T, hkv, dh) -> (..., T, hkv·dh·itemsize) uint8; MLA's (..., T,
    r) -> (..., T, r·itemsize)."""
    t = t.contiguous()
    feat = 1 if cfg.attn_variant == "mla" else 2
    return t.view(torch.uint8).reshape(*t.shape[:-feat], -1)


def _row_bytes(cfg: ModelConfig, comp, index) -> torch.Tensor:
    """The rows ``comp[leaf][index]`` of both leaves as uint8, leaf ‖
    leaf (k ‖ v, or c ‖ krope)."""
    a, b = _row_parts(cfg)
    return torch.cat([_as_bytes(cfg, comp[a][index]),
                      _as_bytes(cfg, comp[b][index])], dim=-1)


def serialize_kv(cfg: ModelConfig, state, slot: int, t0: int,
                 t1: int) -> np.ndarray:
    """-> (n_attn_layers, t1-t0, row_bytes) uint8, row = k ‖ v: built on
    the device, copied to the host once.  Off the serving path: the
    reference's layer-major persist layout, kept for the byte-identity
    tests and as the baseline of chip_smoke.py's persist comparison."""
    return _kv_bytes(cfg, state, slot, t0, t1).cpu().numpy()


def _kv_bytes(cfg: ModelConfig, state, slot: int, t0: int,
              t1: int) -> torch.Tensor:
    """(n_attn_layers, t1-t0, row_bytes) uint8 on the state's device."""
    _kv_rows(cfg)
    return _row_bytes(cfg, state[_state_key(cfg)],
                      (slice(None), slot, slice(t0, t1)))


def serialize_blocks(cfg: ModelConfig, state, slot: int, b0: int, b1: int,
                     block_tokens: int) -> np.ndarray:
    """FullBlocks ``b0 .. b1-1`` of one slot -> (b1-b0, n_attn_layers,
    block_tokens, row_bytes) uint8, block-major, row = k ‖ v (or c ‖
    krope): the DE's
    persist.  The layer-major byte view is built on the device once and
    every layer's LayerBlock stream goes into its FullBlock pages in one
    launch of the ``kv_layer_scatter`` kernel; the block-major pool then
    comes to the host in one copy, so every FullBlock is a contiguous
    ``[i]``."""
    n, bt = b1 - b0, block_tokens
    rows = _kv_bytes(cfg, state, slot, b0 * bt, b1 * bt)    # (L, n·bt, row)
    n_l, _, row = rows.shape
    pool = torch.empty((n, n_l, bt, row), dtype=torch.uint8,
                       device=rows.device)
    table = torch.arange(n, dtype=torch.int32, device=rows.device)
    kv_layer_scatter(pool, table, rows.view(n_l, n, bt, row),
                     layer=range(n_l))
    return pool.cpu().numpy()


def serialize_kv_layer(cfg: ModelConfig, state, slot: int, t0: int,
                       t1: int, layer: int) -> np.ndarray:
    """One attention layer's KV rows -> (t1-t0, row_bytes) uint8."""
    key, idx = _kv_rows(cfg)[layer]
    return _row_bytes(cfg, state[key],
                      idx + (slot, slice(t0, t1))).cpu().numpy()


def _rows_to_kv(cfg: ModelConfig, rows: torch.Tensor, dtype: torch.dtype):
    """(..., T, row_bytes) uint8 -> the row's two leaves of ``dtype``, k,
    v (..., T, hkv, dh) or c (..., T, r), krope (..., T, rd), viewed in
    place on the rows' device (no copy)."""
    lead = rows.shape[:-1]
    if cfg.attn_variant == "mla":
        cut = cfg.mla.kv_lora_rank * rows.shape[-1] // (
            cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
        return (rows[..., :cut].view(dtype).view(*lead, -1),
                rows[..., cut:].view(dtype).view(*lead, -1))
    half = rows.shape[-1] // 2
    shape = (*lead, cfg.n_kv_heads, cfg.head_dim)
    return (rows[..., :half].view(dtype).view(shape),
            rows[..., half:].view(dtype).view(shape))


def deserialize_kv_layer(cfg: ModelConfig, state, slot: int, t0: int,
                         layer: int, rows):
    """Write one layer's (T, row_bytes) uint8 rows (a device tensor, or
    host numpy) into the state in place — the per-LayerBlock placement
    step of layerwise loading.  Returns the state."""
    key, idx = _kv_rows(cfg)[layer]
    comp = state[key]
    a, b = _row_parts(cfg)
    rows = torch.as_tensor(rows, device=comp[a].device)
    x, y = _rows_to_kv(cfg, rows, comp[a].dtype)
    t = x.shape[0]
    comp[a][idx + (slot, slice(t0, t0 + t))] = x
    comp[b][idx + (slot, slice(t0, t0 + t))] = y
    return state


def deserialize_kv(cfg: ModelConfig, state, slot: int, t0: int,
                   kv_bytes: np.ndarray):
    """Write (L, T, row_bytes) uint8 into the padded state in place, all
    layers in one host-to-device copy.  Returns the state."""
    n_l = len(_kv_rows(cfg))
    assert kv_bytes.shape[0] == n_l, (kv_bytes.shape[0], n_l)
    comp = state[_state_key(cfg)]
    a, b = _row_parts(cfg)
    rows = torch.as_tensor(kv_bytes, device=comp[a].device)
    x, y = _rows_to_kv(cfg, rows, comp[a].dtype)
    t = x.shape[1]
    comp[a][:, slot, t0:t0 + t] = x
    comp[b][:, slot, t0:t0 + t] = y
    return state


# ---------------------------------------------------------------------------
# layerwise double-buffered delivery (paper §4.1)
# ---------------------------------------------------------------------------


def layer_stream(cfg: ModelConfig, blocks: List[np.ndarray],
                 tm: Optional[TrafficManager] = None,
                 tclass: TrafficClass = TrafficClass.KV_TRANSFER,
                 device="cuda") -> Iterator[Tuple[int, torch.Tensor]]:
    """Double-buffered per-layer LayerBlock stream from FullBlock pages.

    ``blocks``: the request's hit FullBlocks, each (L, page_tokens,
    row_bytes) uint8.  The stacked pool moves to ``device`` once; yields
    ``(layer, rows)`` with ``rows`` a (n_blocks·page_tokens, row_bytes)
    uint8 tensor on ``device`` from the gather kernel.  Layer i+1's
    gather is submitted to the TrafficManager before layer i is
    yielded, so at most two layer buffers are live."""
    n_l = n_attn_layers(cfg)
    if not blocks or n_l == 0:
        return
    pool = torch.from_numpy(np.stack(blocks)).to(device)  # (n, L, pt, row)
    n, _, pt, row = pool.shape
    table = torch.arange(n, dtype=torch.int32, device=pool.device)
    layer_bytes = int(n * pt * row)
    if tm is None:
        tm = TrafficManager()
    buf: Dict[int, torch.Tensor] = {}

    def fetch(layer: int):
        buf[layer] = kv_layer_gather(pool, table,
                                     layer=layer).reshape(n * pt, row)

    tm.submit(lambda: fetch(0), layer_bytes, tclass)
    for li in range(n_l):
        tm.drain()                            # layer li has landed
        if li + 1 < n_l:                      # layer li+1 goes in flight
            tm.submit(lambda nxt=li + 1: fetch(nxt), layer_bytes, tclass)
        yield li, buf.pop(li)
