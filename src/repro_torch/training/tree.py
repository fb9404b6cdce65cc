"""The trees the port keeps its parameters and optimizer state in: dicts
and lists (``params["blocks"]``, one dict per layer) down to tensor (or,
in Adafactor's state, dict) leaves.  The reference's trees are JAX
pytrees with the layers stacked; these are their unstacked form."""
from __future__ import annotations

from typing import Callable, Iterator, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves of rest at the same path)`` over ``tree``'s
    structure; ``rest`` may hold anything at ``tree``'s leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves_with_paths(tree, path: Tuple[str, ...] = ()) -> Iterator:
    """(path, leaf) pairs, a path being the dict keys and list indices
    down to the leaf, as strings."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_paths(v, path + (str(i),))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(tree, new_leaves) -> object:
    """``tree``'s structure with ``new_leaves`` in :func:`leaves` order."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree)
