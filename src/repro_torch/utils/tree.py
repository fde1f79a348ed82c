"""Tree path utilities (port of ``repro.utils.tree``).

Params are nested dicts of tensors (or ``QuantizedTensor`` leaves),
addressed by '/'-joined key paths, e.g. "attn/wq".
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.quant.types import QuantizedTensor, stack_quantized

Tree = Any


def tree_get(tree: Tree, path: str) -> Any:
    node = tree
    for k in path.split("/"):
        node = node[k]
    return node


def tree_set(tree: Tree, path: str, value: Any) -> Tree:
    """Functional set: a new tree with ``path`` replaced by ``value``."""
    keys = path.split("/")

    def rec(node: Tree, i: int) -> Tree:
        if i == len(keys):
            return value
        new = dict(node)
        new[keys[i]] = rec(node[keys[i]], i + 1)
        return new

    return rec(tree, 0)


def tree_partition(tree: Tree, predicate: Callable[[str], bool],
                   prefix: str = "") -> tuple[Tree, Tree]:
    """Split a nested dict into (matching, rest) by path predicate; the
    other part holds None in each place, so ``tree_merge`` puts them back
    together. Once the predicate matches a subtree's path, the whole
    subtree goes to ``matching``."""
    if not isinstance(tree, dict):
        return (tree, None) if predicate(prefix[:-1]) else (None, tree)
    if prefix and predicate(prefix[:-1]):
        return tree, None
    a: dict = {}
    b: dict = {}
    for k, v in tree.items():
        a[k], b[k] = tree_partition(v, predicate, f"{prefix}{k}/")
    return a, b


def tree_merge(a: Tree, b: Tree) -> Tree:
    """Inverse of ``tree_partition``."""
    if a is None:
        return b
    if b is None:
        return a
    return {k: tree_merge(a.get(k), b.get(k)) for k in a.keys() | b.keys()}


def tree_map(fn: Callable, *trees: Tree) -> Tree:
    """``fn`` over the leaves of same-structured nested dicts; None places
    (``tree_partition``'s holes) stay None."""
    if trees[0] is None:
        return None
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree: Tree) -> list:
    """The leaves of a nested dict in sorted key order (``jax.tree.leaves``'
    order for dicts); None places are skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_stack(trees: list) -> Tree:
    """Stack per-layer trees along a new leading layer dim (packed weights
    included)."""
    if isinstance(trees[0], dict):
        return {k: tree_stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], QuantizedTensor):
        return stack_quantized(trees)
    return torch.stack(trees)


def tree_index(tree: Tree, i: int) -> Tree:
    """Layer i of a scan-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]           # tensors and QuantizedTensor alike
