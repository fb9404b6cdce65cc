"""Trie-indexed KV-Cache (port of ``repro.kvcache.trie``, paper §4.1/§A.5).

Each trie node maps one whole block of token ids to one FullBlock, so a
prefix match walks block by block and hit lengths are multiples of the
block size.  LRU eviction for the online working set arrives with the
online serving slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class _Node:
    ref: Optional[int] = None                 # FullBlock storage ref
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)


class BlockTrie:
    def __init__(self, block_tokens: int):
        self.block_tokens = block_tokens
        self.root = _Node()
        self.n_blocks = 0

    def _blocks_of(self, tokens: Sequence[int]):
        bt = self.block_tokens
        for i in range(len(tokens) // bt):
            yield tuple(tokens[i * bt:(i + 1) * bt])

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix: returns (hit_tokens, block refs)."""
        node, refs = self.root, []
        for key in self._blocks_of(tokens):
            child = node.children.get(key)
            if child is None or child.ref is None:
                break
            refs.append(child.ref)
            node = child
        return len(refs) * self.block_tokens, refs

    def insert(self, tokens: Sequence[int],
               new_refs: Sequence[int]) -> List[int]:
        """Insert blocks covering ``tokens``; ``new_refs`` supplies storage
        refs for blocks not yet present (consumed in order).  Returns the
        refs of the newly inserted blocks."""
        node = self.root
        it = iter(new_refs)
        inserted = []
        for key in self._blocks_of(tokens):
            child = node.children.get(key)
            if child is None:
                child = _Node(ref=next(it))
                node.children[key] = child
                inserted.append(child.ref)
                self.n_blocks += 1
            node = child
        return inserted
