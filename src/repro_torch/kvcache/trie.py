"""Trie-indexed KV-Cache (port of ``repro.kvcache.trie``, paper §4.1/§A.5).

Each trie node maps one whole block of token ids to one FullBlock, so a
prefix match walks block by block and hit lengths are multiples of the
block size.  ``evict_lru`` drops least-recently-used leaf blocks for a
shared online working set.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class _Node:
    ref: Optional[int] = None                 # FullBlock storage ref
    children: Dict[Tuple[int, ...], "_Node"] = field(default_factory=dict)
    last_used: int = 0


class BlockTrie:
    def __init__(self, block_tokens: int):
        self.block_tokens = block_tokens
        self.root = _Node()
        self._clock = itertools.count()
        self.n_blocks = 0

    def _blocks_of(self, tokens: Sequence[int]):
        bt = self.block_tokens
        for i in range(len(tokens) // bt):
            yield tuple(tokens[i * bt:(i + 1) * bt])

    def match(self, tokens: Sequence[int]) -> Tuple[int, List[int]]:
        """Longest cached prefix: returns (hit_tokens, block refs)."""
        node, refs = self.root, []
        tick = next(self._clock)
        for key in self._blocks_of(tokens):
            child = node.children.get(key)
            if child is None or child.ref is None:
                break
            child.last_used = tick
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
        tick = next(self._clock)
        for key in self._blocks_of(tokens):
            child = node.children.get(key)
            if child is None:
                child = _Node(ref=next(it))
                node.children[key] = child
                inserted.append(child.ref)
                self.n_blocks += 1
            child.last_used = tick
            node = child
        return inserted

    def missing_blocks(self, tokens: Sequence[int]) -> int:
        """Number of whole blocks of ``tokens`` not yet in the trie."""
        hit, _ = self.match(tokens)
        return len(tokens) // self.block_tokens - hit // self.block_tokens

    def evict_lru(self, n: int) -> List[int]:
        """Evict up to n least-recently-used *leaf* blocks; returns refs."""
        out = []
        for _ in range(n):
            leaf = self._lru_leaf()
            if leaf is None:
                break
            parent, key, child = leaf
            del parent.children[key]
            if child.ref is not None:
                out.append(child.ref)
                self.n_blocks -= 1
        return out

    def _lru_leaf(self):
        best = None

        def walk(node):
            nonlocal best
            for key, child in node.children.items():
                if not child.children:
                    if best is None or child.last_used < best[2].last_used:
                        best = (node, key, child)
                else:
                    walk(child)

        walk(self.root)
        return best
