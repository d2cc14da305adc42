"""Walk the port's parameter trees: dicts, lists, tuples (named ones
too, such as ``AdamState``) and dataclasses (``Linear``, ``Conv``, the
quantized tensors) with tensors at the leaves.

The JAX package gets this from pytrees; here a parameter tree is plain
Python containers, so one small walker serves device moves, quantization
and byte counts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn: Callable, tree: Any, *,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """Apply ``fn`` to every tensor (or every node ``is_leaf`` accepts),
    rebuilding the containers around the results."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf=is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(tree_map(fn, v, is_leaf=is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf=is_leaf) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {f.name: tree_map(fn, getattr(tree, f.name), is_leaf=is_leaf)
                   for f in dataclasses.fields(tree)}
        return dataclasses.replace(tree, **changes)
    return tree


def tree_leaves(tree: Any, *,
                is_leaf: Callable[[Any], bool] | None = None) -> list:
    """Tensors (or ``is_leaf`` nodes) of ``tree`` in traversal order."""
    out: list = []
    tree_map(lambda x: out.append(x) or x, tree, is_leaf=is_leaf)
    return out


def to_device(tree: Any, device) -> Any:
    """Move every tensor of ``tree`` to ``device`` (no copy when it is
    already there)."""
    return tree_map(lambda t: t.to(device), tree)
