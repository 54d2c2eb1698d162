"""Minimal tree helpers for the port's param trees: nested dicts, lists and
tuples whose leaves are tensors (or other objects, such as quantized
weights, kept whole); ``None`` holds no leaf.  Leaves come in a fixed
order: dict keys in insertion order, sequences by index."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in order."""
    out: List[Any] = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif node is not None:
            out.append(node)

    walk(tree)
    return out


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return None if node is None else next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_leaves(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *others,
                                                   strict=True)])
