"""KV-Cache storage (port of ``repro.kvcache.store``).

FullBlocks in, FullBlocks out, with byte accounting.  Storage sits off
the card, so a FullBlock is a host numpy array ``(layers, block_tokens,
row_bytes)`` uint8: persisting is a device-to-host copy and the
layerwise install moves the hit blocks to the card once per request.
A node's DRAM tier (``kvcache/tiers.py``) sits in front of this store.
``AccountingKVStore`` keeps the byte and call counters with no payloads.
``StateBlobStore`` holds the SSM family's state snapshots, keyed by the
exact context they were taken at.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.blocks import BlockLayout


class KVStore:
    """Abstract FullBlock store with read/write byte accounting."""

    def __init__(self, layout: BlockLayout):
        self.layout = layout
        self._refs = itertools.count(1)
        self.bytes_read = 0
        self.bytes_written = 0
        self.reads = 0
        self.writes = 0

    def alloc_ref(self) -> int:
        return next(self._refs)

    def write_block(self, ref: int, block) -> None:
        self.bytes_written += self.layout.full_block_bytes
        self.writes += 1
        self._put(ref, block)

    def read_block(self, ref: int):
        self.bytes_read += self.layout.full_block_bytes
        self.reads += 1
        return self._get(ref)

    def read_blocks(self, refs: Sequence[int]) -> List:
        return [self.read_block(r) for r in refs]

    def peek(self, ref: int):
        """Payload access with no byte accounting: warming a DRAM tier
        with blocks that already moved through the node (the DE's whole
        context at round end) must not charge the storage NIC again."""
        return self._get(ref)

    def _put(self, ref, block):  # pragma: no cover - abstract
        raise NotImplementedError

    def _get(self, ref):  # pragma: no cover - abstract
        raise NotImplementedError


class MemoryKVStore(KVStore):
    """In-memory FullBlock store."""

    def __init__(self, layout: BlockLayout):
        super().__init__(layout)
        self._data: Dict[int, np.ndarray] = {}
        self._lock = threading.Lock()

    def _put(self, ref: int, block: np.ndarray):
        assert block.shape == self.layout.full_block_shape(), (
            block.shape, self.layout.full_block_shape())
        with self._lock:
            self._data[ref] = block

    def _get(self, ref: int) -> np.ndarray:
        with self._lock:
            return self._data[ref]


class AccountingKVStore(KVStore):
    """Byte-accounting-only store: counts reads and writes, keeps no
    payload."""

    def _put(self, ref, block):
        pass

    def _get(self, ref):
        return None


class StateBlobStore:
    """Exact-prefix state snapshots for SSM archs.

    Attention-free layers have no per-token KV: their cache is the O(1)
    recurrent state, reusable only at the exact context where it was
    snapshotted.  Agentic replay continues exactly at the previous round
    end, so an exact-match store mirrors the trie's role.  A blob is the
    state's raw bytes (``kvio.state_to_blob``), a 1-D uint8 array, so
    ``len(blob)`` is its byte count.
    """

    def __init__(self):
        self._blobs: Dict[tuple, Tuple[np.ndarray, int]] = {}
        self.bytes_read = 0
        self.bytes_written = 0

    def put(self, key_tokens: Sequence[int], blob: np.ndarray, length: int):
        self._blobs[tuple(key_tokens)] = (blob, length)
        self.bytes_written += len(blob)

    def get(self, key_tokens: Sequence[int]
            ) -> Tuple[Optional[np.ndarray], int]:
        hit = self._blobs.get(tuple(key_tokens))
        if hit is None:
            return None, 0
        self.bytes_read += len(hit[0])
        return hit
