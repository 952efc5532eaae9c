"""Minimal pytree helpers for nested dicts/lists of tensors."""

from __future__ import annotations

from typing import Callable, Iterator, Tuple


def tree_map(fn: Callable, tree, path: str = ""):
    """Apply ``fn(path, leaf)`` to every non-None leaf; containers and
    ``None`` entries keep their structure.  ``path`` is '/'-joined."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, f"{path}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, f"{path}{i}/") for i, v in enumerate(tree)]
    return fn(path[:-1], tree)


def tree_map2(fn: Callable, a, b):
    """Apply ``fn(leaf_a, leaf_b)`` over two trees of the same structure."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [tree_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def tree_leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """Yield ``(path, leaf)`` in insertion order, skipping ``None``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}{i}/")
    else:
        yield path[:-1], tree
