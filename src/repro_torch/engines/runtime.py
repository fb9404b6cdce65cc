"""Inference engines: layerwise-prefill PE and slot-batched decode DE
(port of ``repro.engines.runtime``: the dense and MoE families, GQA or
MLA attention, and the SSM and hybrid families' state blobs).

* ``PrefillEngine`` — hit KV arrives as host FullBlocks and is installed
  layer by layer on the card (``kvio.layer_stream``, the gather kernel);
  the prompt is then prefilled in quota-packed chunks through
  ``model.append_step`` (the flash kernel) against a per-request padded
  state.  ``chunk_tokens`` caps each slice (chunked prefill) and
  ``class_aware`` orders the fifo by SLO class, so an interactive round
  may overtake a part-prefilled batch round.
* ``DecodeEngine`` — slot-batched decode through ``model.decode_step``
  (the paged kernel); each newly filled FullBlock persists to storage
  (``kvio.serialize_blocks``, the scatter kernel) and enters the trie
  (paper: persist per 64-token block).  Its store is the node's DRAM
  tier when the system has one (write-through and tier warm-up).

Transfers ride each engine's TrafficManager as
``TrafficClass.KV_TRANSFER``.  The SSM and hybrid families carry an
opaque state blob instead of FullBlocks (constant-size recurrent state,
and the hybrid's shared K/V padded to ``max_seq``): the PE
installs a hit's blob in one host-to-device copy (``kvio.blob_to_state``)
and the DE persists a finished round's state as one blob
(``kvio.state_to_blob``) into the ``StateBlobStore``, keyed by the exact
context.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.blocks import BlockLayout
from repro_torch.core.intra import (AttnTimeModel, BatchItem, PrefillWork,
                                    QuotaPacker, class_insert_index)
from repro_torch.core.scheduler import Request
from repro_torch.core.traffic import TrafficClass, TrafficManager
from repro_torch.engines import kvio
from repro_torch.kvcache.store import MemoryKVStore, StateBlobStore
from repro_torch.kvcache.trie import BlockTrie
from repro_torch.models.model import (append_step, decode_step,
                                      init_decode_state)


def uses_state_blob(cfg: ModelConfig) -> bool:
    return cfg.family in ("ssm", "hybrid")


@dataclass
class EngineRequest:
    """A request with its token payload, as the engines see it."""

    req: Request
    context_tokens: List[int]        # full previous context (hit source)
    append_tokens: List[int]         # new tokens to prefill
    hit_refs: List[int] = field(default_factory=list)
    state: Any = None                # per-request (b=1) model state
    length: int = 0                  # tokens materialised in state
    generated: List[int] = field(default_factory=list)
    first_token: Optional[int] = None
    # serving-runtime bookkeeping (serving/system.py)
    session: Any = None
    lifecycle: Any = None
    read_payload: List[Optional[np.ndarray]] = field(default_factory=list)
    # the state blob of the context (SSM family), found at submission
    blob: Optional[np.ndarray] = None
    pd_ready: bool = False
    # (node, refs) of the DRAM-tier prefix pinned from the path decision
    # until the read copies it out
    tier_pinned: Optional[Tuple[int, List[int]]] = None
    # re-homed after an engine death: every stale completion discards it
    cancelled: bool = False
    # the open lifecycle span (traced runs only): state name and start
    span_state: Optional[str] = None
    state_t0: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return len(self.context_tokens) + len(self.append_tokens)


class PrefillEngine:
    def __init__(self, eid, cfg: ModelConfig, params, max_seq: int,
                 quota_s: float = 0.300, layerwise: bool = True,
                 chunk_tokens: Optional[int] = None,
                 class_aware: bool = False, device="cuda"):
        self.eid = eid
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.layerwise = layerwise
        self.device = torch.device(device)
        self.tm = TrafficManager()
        self.packer = QuotaPacker(cfg, AttnTimeModel.from_config(cfg),
                                  quota_s=quota_s, chunk_tokens=chunk_tokens)
        self.class_aware = class_aware
        self.fifo: List[Tuple[PrefillWork, EngineRequest]] = []
        self.prefill_tokens = 0
        # (cached, bsz) items of the batch the last step() executed — the
        # serving clock's compute-duration input
        self.last_step_items: List[Tuple[int, int]] = []
        # requests whose last-step item was a partial (chunked) slice and
        # whose prefill is unfinished: the PREFILL_CHUNKED sub-state
        self.last_step_chunked: List[EngineRequest] = []

    # -- loading ---------------------------------------------------------
    def install_hit_kv(self, er: EngineRequest, payload):
        """payload: the hit FullBlocks, or for the SSM family the state
        blob (or None).  With ``layerwise`` (paper §4.1) FullBlocks are
        installed one LayerBlock at a time from the gather kernel's
        stream; otherwise in one bulk copy (Fig. 12 ablation).  A blob
        goes to the card whole."""
        hit = er.req.cached_tokens
        if uses_state_blob(self.cfg) and payload is not None:
            er.state = kvio.blob_to_state(self.cfg, payload, self.device,
                                          self.max_seq)
            payload = None
        else:
            er.state = init_decode_state(self.cfg, 1, self.max_seq,
                                         self.device)
        if payload:
            if self.layerwise:
                for li, rows in kvio.layer_stream(self.cfg, payload,
                                                  tm=self.tm,
                                                  device=self.device):
                    kvio.deserialize_kv_layer(self.cfg, er.state, 0, 0, li,
                                              rows[:hit])
            else:
                kv_bytes = np.concatenate(payload, axis=1)   # (L, hit, row)
                kvio.deserialize_kv(self.cfg, er.state, 0, 0,
                                    kv_bytes[:, :hit])
        er.length = hit
        work = PrefillWork(er.req.rid, hit, len(er.append_tokens),
                           rank=er.req.class_rank, arrival=er.req.arrival)
        if self.class_aware:
            # the TTFT wait accrues here, so the class order extends to
            # the fifo
            self.fifo.insert(class_insert_index(
                [w.key() for w, _ in self.fifo], work.key()), (work, er))
        else:
            self.fifo.append((work, er))

    # -- compute ---------------------------------------------------------
    def step(self) -> List[EngineRequest]:
        """Run one quota-packed forward batch; returns requests whose
        prefill completed this step."""
        self.last_step_items = []
        self.last_step_chunked = []
        if not self.fifo:
            return []
        works = [w for w, _ in self.fifo]
        byrid = {w.rid: er for w, er in self.fifo}
        batch = self.packer.pack(works)
        if not batch and works:
            # quota below min_chunk for the head request: force minimal
            # progress so the engine never stalls
            w = works[0]
            bsz = min(w.remaining, self.packer.min_chunk)
            batch = [BatchItem(w.rid, w.cached, bsz, chunked=True)]
            w.advance(bsz)
            if w.remaining == 0:
                works.pop(0)
        self.fifo = [(w, byrid[w.rid]) for w in works]
        self.last_step_items = [(bi.cached, bi.bsz) for bi in batch]
        done = []
        for bi in batch:
            er = byrid[bi.rid]
            lo = bi.cached - er.req.cached_tokens
            t = torch.tensor([er.append_tokens[lo:lo + bi.bsz]],
                             dtype=torch.long, device=self.device)
            lengths = torch.tensor([er.length], device=self.device)
            logits, er.state = append_step(self.params, self.cfg, t,
                                           er.state, lengths)
            er.length += bi.bsz
            self.prefill_tokens += bi.bsz
            if er.length == er.prompt_len:
                er.first_token = int(torch.argmax(logits[0, -1]))
                done.append(er)
            elif bi.chunked:
                self.last_step_chunked.append(er)
        return done


class DecodeEngine:
    def __init__(self, eid, cfg: ModelConfig, params, store: MemoryKVStore,
                 trie: BlockTrie, layout: BlockLayout, max_seq: int,
                 n_slots: int = 8, device="cuda",
                 blob_store: Optional[StateBlobStore] = None):
        self.eid = eid
        self.cfg = cfg
        self.params = params
        self.store = store
        self.blob_store = blob_store
        self.trie = trie
        self.layout = layout
        self.max_seq = max_seq
        self.n_slots = n_slots
        self.device = torch.device(device)
        self.tm = TrafficManager()
        self.state = init_decode_state(cfg, n_slots, max_seq, self.device)
        self.axes = kvio.batch_axes_of_state(cfg)
        self.slots: List[Optional[EngineRequest]] = [None] * n_slots
        self.lengths = np.zeros(n_slots, np.int64)
        self.next_token = np.zeros(n_slots, np.int64)
        self.decode_steps = 0
        # context lengths the last step() decoded over (serving clock)
        self.last_step_ctxs: List[int] = []
        # pipelined persistence: with defer_persist the block writes are
        # submitted but not drained, and (request, finalize) pairs park
        # here until the system flushes the tm; finalize inserts the trie
        # entries once the writes have landed
        self.defer_persist = False
        self.pending_persist: List[Tuple[EngineRequest,
                                         Optional[Callable]]] = []

    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    def admit(self, er: EngineRequest) -> int:
        slot = self.slots.index(None)
        self.slots[slot] = er
        kvio.slot_set(self.state, self.axes, slot, er.state)
        self.lengths[slot] = er.length
        self.next_token[slot] = er.first_token
        er.generated.append(er.first_token)
        er.state = None                      # DE owns the state now
        return slot

    def step(self) -> List[EngineRequest]:
        """One decode step over all slots; returns the finished requests."""
        self.last_step_ctxs = [int(self.lengths[s])
                               for s, er in enumerate(self.slots)
                               if er is not None]
        if all(s is None for s in self.slots):
            return []
        toks = torch.from_numpy(self.next_token).to(self.device)
        lengths = torch.from_numpy(self.lengths).to(self.device)
        logits, self.state = decode_step(self.params, self.cfg, toks,
                                         self.state, lengths)
        self.decode_steps += 1
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        finished = []
        for slot, er in enumerate(self.slots):
            if er is None:
                continue
            self.lengths[slot] += 1
            self.next_token[slot] = nxt[slot]
            if len(er.generated) < er.req.gen_tokens:
                er.generated.append(int(nxt[slot]))
            if len(er.generated) >= er.req.gen_tokens:
                self._persist(slot, er)
                finished.append(er)
                self.slots[slot] = None
                self.lengths[slot] = 0
        return finished

    # -- persistence (per full block, as in the paper) --------------------
    def _persist(self, slot: int, er: EngineRequest):
        """Serialise the slot's new blocks now, through the scatter kernel
        into a pool of their own (the slot may be re-admitted before
        deferred writes land), and submit the storage writes; with
        ``defer_persist`` the writes and the trie insert wait in
        ``pending_persist`` for the system's flush."""
        full_tokens = er.context_tokens + er.append_tokens + er.generated
        if uses_state_blob(self.cfg):
            # the slot's whole state, snapshotted now, as one blob
            blob = kvio.state_to_blob(
                kvio.slot_get(self.state, self.axes, slot))
            self.tm.submit(
                lambda b=blob, k=tuple(full_tokens), n=int(self.lengths[slot]):
                self.blob_store.put(k, b, n),
                len(blob), TrafficClass.KV_TRANSFER)
            if self.defer_persist:
                self.pending_persist.append((er, None))
            else:
                self.tm.drain()
            return
        bt = self.layout.block_tokens
        n_blocks = len(full_tokens) // bt
        start_block = er.req.cached_tokens // bt
        if n_blocks <= start_block:
            if self.defer_persist:
                self.pending_persist.append((er, None))
            return
        blocks = kvio.serialize_blocks(self.cfg, self.state, slot,
                                       start_block, n_blocks, bt)
        new_refs = [self.store.alloc_ref()
                    for _ in range(n_blocks - start_block)]
        for ref, blk in zip(new_refs, blocks):
            self.tm.submit(lambda r=ref, b=blk: self.store.write_block(r, b),
                           blk.nbytes, TrafficClass.KV_TRANSFER)
        finalize = lambda toks=full_tokens[:n_blocks * bt], refs=new_refs: \
            self.trie.insert(toks, refs)
        if self.defer_persist:
            self.pending_persist.append((er, finalize))
        else:
            self.tm.drain()
            finalize()
